"""Migration shims: the reference's ``edge.*`` module paths.

Counterpart of ``audio_processing_tools_tpu/edge/``.  Users of
``audio_processing_tools.edge.<module>`` (or of the JAX package's
``audio_processing_tools_tpu.edge.<module>``) can switch their imports to
``audio_processing_tools_tpu_torch.edge.<module>`` and find the same names;
each shim re-exports them from the port's modules.
"""
