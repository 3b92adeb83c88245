"""Bidirectional multi-layer LSTM in the reference's layout.

Counterpart of ``multipitch_architectures_tpu/ops/lstm.py``, which runs
the recurrence as a ``lax.scan`` with torch ``nn.LSTM``'s weights. Here
it is ``nn.LSTM`` itself (cuDNN's LSTM on the card): the same parameters
``weight_ih_l{k}`` ``(4H, in)`` with gate rows [i; f; g; o],
``weight_hh_l{k}``, separate ``bias_ih_l{k}`` and ``bias_hh_l{k}``, a
``_reverse`` suffix for the backward direction, and layer k > 0 taking
both directions' outputs (2H). cuDNN runs it in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off (``set_f32_parity``).
"""

from torch import nn


class TorchLSTM(nn.LSTM):
    """Input and output ``(B, T, features)`` (batch first, as the
    reference); returns the output sequence only."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = True):
        super().__init__(input_size, hidden_size, num_layers,
                         batch_first=True, bidirectional=bidirectional)

    def forward(self, x):
        return super().forward(x)[0]
