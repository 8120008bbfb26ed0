"""PowerTCP reproduction on PyTorch and CUDA (the port of ``repro``).

The fluid simulator, its control laws and its hot-spot kernels, written
for one NVIDIA H100: plain tensor code is PyTorch, and the kernels that
``repro`` wrote in Pallas are CUDA C++ written by hand for ``sm_90a``
(``repro_torch/csrc``). Module names and structure mirror ``repro``:
``repro_torch.core.fluid.slot_step`` is the twin of
``repro.core.fluid.slot_step``.

f32 policy: every simulator carry is float32 or int32
(``core.fluid.audit_carry_dtypes``). TensorFloat-32 is switched off here
so that no float32 product on the card silently drops to a 10-bit
mantissa; the simulator itself does no matrix product outside its own
kernels, but a caller that does gets full float32. The LM stack's
bfloat16 products (``models/layers.py``) accumulate in float32 to the
end, as ``repro``'s do: cuBLAS's reduced-precision reduction is off too.

Eager PyTorch rounds every operation on its own, so the XLA guards of
``repro`` (``laws._pin``, ``laws._nofma``) have no counterpart here; the
CUDA kernels are built with ``-fmad=false`` for the same reason
(``kernels/_build.py``).
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
