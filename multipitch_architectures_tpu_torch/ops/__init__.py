from .attention import TorchMultiheadAttention, sinusoidal_positional_encoding
from .resize import up_concat_pad
