"""One module a configuration's ``model``: ``models/<model>.py`` holds
``per_clip(params, x, store=None)``, the step's per-clip outputs of that
model for the float32 clips ``x`` (B, N) as tensors."""
