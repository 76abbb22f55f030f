"""The benchmark's plain reference of LM2A: plain PyTorch, float32, no
kernels, no caches, no batching tricks.

A frozen, independent statement of the model that the port under test must
agree with: both denoisers (``unet``), the condition projection, the
diffusion loss and the DDIM sampler with classifier-free guidance
(``diffusion``), clip + Adan + EMA (``adan``), BigVGAN in its published
alias-free form (``bigvgan``) and the condition resampling (``resample``).
Parameters are flat dicts keyed by the port's parameter names, so one set of
weights made by the benchmark loads into both sides.

Every matrix product and convolution reads its operands through a
``Precision`` (``precision``): exact float32 for the reference, rounded to
a lower precision for the control that the limits are set against.

This package imports nothing of the program under test.
"""
