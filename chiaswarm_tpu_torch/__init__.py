"""chiaswarm_tpu_torch — the PyTorch/CUDA port of chiaswarm_tpu.

The JAX package ``chiaswarm_tpu`` is the reference; this package grows beside
it, slice by slice, until it serves everything the JAX package does on an
NVIDIA H100. It imports ``torch`` and never ``jax``, ``flax`` or anything
under ``chiaswarm_tpu``: where it needs a JAX module that is free of JAX, it
keeps its own trimmed copy, whose docstring names the source file.

Layer map (mirrors the JAX package's names):

- ``core``       — device slots, per-row RNG, shape buckets
- ``ops``        — attention dispatch and the hand-written CUDA kernels
                   (``csrc/*.cu``, built with nvcc at first use)
- ``models``     — CLIP text encoder, UNet, VAE as ``nn.Module``s with
                   diffusers' parameter names, NCHW inside
- ``schedulers`` — noise schedules and sampler steps
- ``convert``    — JAX/Flax param trees -> the port's state dicts
- ``pipelines``  — components and the txt2img pipeline
- ``workloads``  — job callbacks
- ``node``       — job routing, the executor, the artifact envelope
- ``serving``    — output screening
- ``cli``        — the operator CLI (``python -m chiaswarm_tpu_torch.cli``)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

WORKER_VERSION = __version__
