from .attention import TorchMultiheadAttention, sinusoidal_positional_encoding
from .lstm import TorchLSTM
from .resize import up_concat_pad, upsample_bilinear_align_corners
