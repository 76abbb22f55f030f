"""lm2a_tpu_torch: the PyTorch + CUDA port of ``lm2a_tpu`` for an NVIDIA H100.

The JAX package ``lm2a_tpu`` stays the reference; this package mirrors its
module tree and names, in plain PyTorch, and replaces each Pallas TPU kernel
on the ported path with a CUDA kernel written for Hopper (``csrc/``):

- ``core``       configs (jax-free copy) and device resolution
- ``data``       npz sample schema, datasets, packing, the native batch
                 gatherer, batching, prefetch, raw-tree preprocessing, split
- ``ops``        condition resampling, motion features, the fused resblock
                 chain and its backward, attention, the fused Adan+EMA
                 update, kernel build
- ``models``     CondProjection, cross-attention, UNet1DUltimate and the v1
                 UNet1D (serving and training forms)
- ``diffusion``  beta schedule, the training loss, DDPM/DDIM samplers with CFG
- ``training``   Adan, train/eval steps, full-state checkpoints, the loop,
                 progressive distillation
- ``inference``  checkpoint -> mel sampling, long form
- ``vocoder``    BigVGAN generator with the fused snake sandwich
- ``cli``        ``python -m lm2a_tpu_torch.cli distill|pack|sample|serve|towav|train``
- ``checkpoint`` / ``convert``  JAX checkpoint directories in and out

Public functions keep the JAX layout, channels-last ``(B, T, C)``. Entry
points run on CUDA unless ``device="cpu"`` is passed; on the CPU every
kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
