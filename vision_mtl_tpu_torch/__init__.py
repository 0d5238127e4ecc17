"""PyTorch/CUDA port of vision_mtl_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module layout so each module's counterpart is
easy to find. It imports ``torch`` and ``numpy`` and nothing of JAX or of
``vision_mtl_tpu``. Public functions keep the JAX layout: NHWC images,
``(B, H, W)`` int masks, ``(B, H, W, 1)`` depth. Entry points run on
``device="cuda"`` unless the caller asks for the CPU.
"""
