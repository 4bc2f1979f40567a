"""imagent_tpu_torch — the PyTorch/CUDA port of ``imagent_tpu``.

A second package beside the JAX one, mirroring its module names. It
imports ``torch`` and ``numpy`` and nothing of JAX or of ``imagent_tpu``
(it keeps its own copies of the host-side modules it needs). Entry
point: ``python -m imagent_tpu_torch``; it runs on the CUDA card unless
``--backend cpu`` is given. The kernels (flash attention, the fused
ConvNeXt MLP, the fused ResNet bottleneck) are hand-written CUDA for
Hopper (``csrc/``), built on first use.
"""
