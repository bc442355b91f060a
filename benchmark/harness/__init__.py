"""The benchmark harness of ``audio_processing_tools_tpu_torch``.

``run.py`` drives one cell: ``spec`` finds the cell's configuration,
traffic mix and metrics by the names in ``BENCHMARK.json``; ``traffic``
makes the backlog from the seed; ``window`` drives the fleet backfill's
step over it; ``trace`` reads the profiler's trace of a traced segment;
``work`` holds the operations and bytes of the kernels the rooflines read
and the table of peaks; ``check`` compares the window's answers with the
plain reference (``plainref``).  Nothing here imports JAX or the JAX
package.
"""
