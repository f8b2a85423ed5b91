"""PyTorch/CUDA port of the MKOR package ``repro``.

The JAX package under ``src/repro/`` stays the numerical reference; this
package mirrors its layout (``models/``, ``core/``, ``kernels/``,
``training/``, ``data/``, ``configs/``, ``launch/``) so each module's
counterpart is easy to find.  It imports ``torch`` and numpy only — never
``jax`` and nothing of ``repro`` — and keeps its own copies of the
JAX-free modules it needs (model configs, the registry, the synthetic data
pipeline).

Idiom: plain functions over dict parameter trees that mirror the JAX trees
(so :mod:`repro_torch.interop` can carry weights across), an explicit
``device``, explicit ``torch.Generator``s.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; with no GPU and no such request
they raise (:func:`repro_torch.device.resolve_device`).  The MKOR hot loop
runs through hand-written CUDA kernels (``csrc/``, bound in
:mod:`repro_torch.kernels`); on CPU tensors the kernel wrappers run their
plain PyTorch versions instead, which is what the CPU tests exercise.
"""
