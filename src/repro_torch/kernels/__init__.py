"""Hand-written Hopper kernels for the perf-critical compute of VersaQ-3D.

- quant_matmul.py: INT8/packed-INT4 tensor-core matmul (the reconfigurable
  PE array; ``csrc/quant_matmul.cu``)
- two_stage_attention.py: paper Alg. 1, stats pass + recompute pass in one
  launch (``csrc/two_stage_attention.cu``)
- fused.py: the unified datapath (§IV-B) — ``fused_matmul``, ``fused_ffn``
  and ``norm_quant`` (``csrc/fused_matmul.cu``, ``fused_ffn.cu``,
  ``norm_quant.cu``, sharing ``csrc/fused_rows.cuh``; ``norm_quant.cu``
  keeps its rows in registers through ``csrc/rows_async.cuh``)
- wht.py: blocked Walsh-Hadamard transform (``csrc/wht.cu``, on
  ``csrc/rows_async.cuh``)

Each module holds its kernel's wrapper and its plain PyTorch version;
``ops.py`` holds the public wrappers, ``_build.py`` the nvcc build, and
``probe.py`` the launch counters, ``measure.py`` the on-card timing and
flip counts of ``chip_smoke.py`` and ``tools/``.  Importing these modules
builds nothing.
"""
