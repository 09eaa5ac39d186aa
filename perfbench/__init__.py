"""The benchmark of ``fdtpu_torch``, the PyTorch + CUDA face-detection
framework, on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything is found by name from the cell's entry:

* ``configs/<config>.json``: the model's sizes, its source and cuts, and
  its family's two modules (``families.py``): its plain reference,
  ``reference/<reference>.py``, and how the program builds it,
  ``programs/<family>.py``;
* ``traffic/<mix>.json``: the parameters of a traffic mix, read by the
  module its ``mode`` names (``modes/train.py``, ``modes/stream.py``) and
  by the one data generator (``data.py``);
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``layer_metrics/<metric>.py``: the reader of one per-layer metric.

The yardstick lives here too: the peaks and the operation and byte counts
(``roofline/``), the trace reduction (``trace.py``), the plain references
(``reference/``) and the comparison (``judge.py``). Nothing here imports
JAX or the JAX package ``fdtpu``; nothing under ``reference/`` imports
``fdtpu_torch``.
"""
