"""The benchmark of ``team_tpu_torch`` on an NVIDIA H100.

``BENCHMARK.json`` at the repository root names the cells (a model
configuration under a traffic mix) and the metrics. Everything that belongs to
one configuration, traffic mix, per-layer metric or kernel family is a file of
its own, found by name:

- ``configs/<config>.json`` (the file the ``configs`` entry names): the
  model's published sizes, how the runtime is configured, and the number and
  limit of the output check;
- ``traffic/<traffic>.json``: the parameters of a traffic mix, among them
  the ``driver`` that runs it;
- ``drivers/<driver>.py``: the system under test for a kind of traffic, its
  steps and its output check (``encode``: ``BackboneRuntime.encode_image``
  on image batches that :mod:`teambench.traffic` draws);
- ``metrics/<metric>.py``: a reader with ``read(readings)`` that returns the
  metric (end-to-end or per-layer), or ``None`` where the run has nothing for
  it to read;
- ``kernels/<family>.json``: the name patterns of a kernel family, its layer,
  its operands' precision and the work function (:mod:`teambench.work`) its
  layer's roofline is read against.

One run of one cell, from the root of a checkout::

    python3 teambench/run.py --workload vitb16-bf16.encode-b128 --seed 7 --seconds 30 --trace 0

prints one JSON line (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``).
The plain reference (:mod:`teambench.reference`) imports nothing of the
program; the ``encode`` driver takes from the program only ``BackboneRuntime``.
"""
