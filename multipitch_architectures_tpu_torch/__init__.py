"""multipitch_architectures_tpu_torch: the PyTorch and CUDA port of
``multipitch_architectures_tpu``, for one NVIDIA H100.

It keeps the JAX package's subpackage and module names, so each module's
counterpart is easy to find, and its public layouts: HCQT ``(6, T, 216)``,
model input NCHW ``(B, 6, 75, 216)``, windowed output ``(B, 1, 1, 72)``.

- ``dsp``         audio -> multirate CQT -> efficient 6-channel HCQT
- ``data``        context windows, the augmentation chain and the
                  device-resident training pipeline
- ``ops``         attention, up-concat, the CQT octave kernel
                  (``csrc/cqt_octave.cu``) and the int8 GEMM
                  (``csrc/int8_gemm.cu``), built with nvcc at first use
- ``models``      SAUnet and its layers, and the bridge from the JAX
                  package's weights
- ``train``       AdamW trainer, losses, schedulers, early stopping
- ``experiments`` the experiment registry (read from the JAX package's
                  ``registry.json`` as data), the runner and its CLI
- ``eval``        the windowed framewise inference protocol (also
                  sharded over a device mesh), its int8 (W8A8) serving
                  mode with the drift gate, and the evaluation measures
- ``parallel``    the ("data", "model") device mesh: data- and
                  tensor-parallel training with global-batch BatchNorm,
                  dropout and cross-batch attention, one process driving
                  every shard

It imports torch and never JAX. Functions run where their tensors lie;
entry points take a ``device``, run on the card by default, and raise
without one unless given ``device="cpu"``.
"""

import torch

__version__ = "0.1.0"


def set_f32_parity() -> None:
    """Run float32 matmuls and convolutions in full float32 on the card.

    PyTorch sends float32 convolutions through cuDNN in TF32 by default,
    which keeps about three decimal digits; the port is held against the
    JAX package in float32, so every parity run, test and smoke run calls
    this first.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``device`` when given, else the card.
    Without a card and without ``device`` it raises: nothing falls back
    to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("this entry point runs on the card by default "
                           "and there is none: pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")
