"""The JAX package's experiment tools, ported: the LOI selector's refit
(report §IV-C) and the paper's LOA, LOI and fusion ablations.

Each runs as ``python -m hcspmm_tpu_torch.tools.<name>`` with the flags,
environment variables, printed lines and JSONL keys of ``tools/<name>.py``:

- ``calibrate_loi``: time the dense-window and ELL paths of the row layout
  on windows of one shape each (a grid, or the bins of a graph's window
  histogram with ``--mixed``) and fit the logistic selector to the faster
  path;
- ``ablate_loi``: sweep the selector's bias on a locality graph;
- ``ablate_loa``: no reorder, LOA and cluster order in the row layout;
- ``ablate_fusion``: the GCN backward core fused and composed (the
  paper's Table VI).

They run on the CUDA device and raise without one unless given
``--device cpu``, where the host clock times the kernels' plain versions.
``common`` holds the graph helpers and the timer they share.
"""
