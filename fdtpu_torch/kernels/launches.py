"""The one count of kernel launches on the card.

:data:`LAUNCHES` counts every launch of the port's kernels by name, whether
it ran eagerly, in a warm-up before a capture or in a CUDA graph's replay.
Each wrapper adds one where it launches; ``utils/graphs.py`` takes a
capture's launches back out (the capture runs nothing) and adds a graph's
launches to it on every replay. A reader takes the difference of two
copies. The names:

* ``decode_filter_nms`` (K1), and ``decode_filter_nms_scratch`` for those
  of its launches that work in global scratch (``kernels/nms.py``);
* ``shear_rows``, and ``shear_rows_stacked`` for those with ``c = 1`` (K4's
  layout), and ``shear_cols`` (``kernels/rotate.py``);
* ``photometric`` (``kernels/photometric.py``);
* ``residual_tail`` (``kernels/epilogue.py``);
* ``bn_act`` (``kernels/bn_act.py``);
* ``conv_gemm``: the library GEMMs of ``kernels/conv_gemm.py``.

It imports nothing of the port, so that any module may read it.
"""

import collections

LAUNCHES: collections.Counter = collections.Counter()
