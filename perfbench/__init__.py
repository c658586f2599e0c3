"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the root of the repository names its cells; the
harness finds each name's file here:

    configs/<config>.json       a configuration: kind, taps, domain, dtype,
                                boundary
    references/<kind>.py        the plain reference of a kind of
                                configuration, which decides ``correct``
    traffic/<traffic>.json      a traffic mix: its generator and parameters
    generators/<generator>.py   sets a cell up and drives the program
                                through the measured window
    cells/<workload>.json       a cell's limits and its own mix parameters
    metrics/<metric>.py         the reader of one metric

A new cell, mix, kind or metric is a new file.  ``run.py`` runs one cell
once; ``harness.py`` resolves the names; ``window.py`` holds what a
window gives back; ``yardstick.py`` the peaks and bound counts;
``trace.py`` the spans and the device trace.  ``check_harness.py`` and
``check_correct.py`` are checks run by name (not collected by pytest);
``sweep_serve.py`` finds a serving mix's highest sustained rate.
Nothing here imports JAX or the JAX package ``repro``.
"""
