"""multipitch_architectures_tpu_torch: the PyTorch and CUDA port of
``multipitch_architectures_tpu``, for one NVIDIA H100.

It keeps the JAX package's subpackage and module names, so each module's
counterpart is easy to find, and its public layouts: HCQT ``(6, T, 216)``,
model input NCHW ``(B, 6, 75, 216)``, windowed output ``(B, 1, 1, 72)``.

- ``dsp``         audio -> multirate CQT -> efficient 6-channel HCQT
- ``data``        stride-1 context windows
- ``ops``         attention, up-concat, and the CQT octave kernel
                  (``csrc/cqt_octave.cu``, built with nvcc at first use)
- ``models``      SAUnet and its layers, and the bridge from the JAX
                  package's weights
- ``experiments`` the experiment registry (read from the JAX package's
                  ``registry.json`` as data)
- ``eval``        the windowed framewise inference protocol

It imports torch and never JAX. Functions run where their tensors lie;
entry points take an explicit ``device``.
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
