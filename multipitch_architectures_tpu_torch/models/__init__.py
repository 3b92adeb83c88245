from .layers import (ConvBlock, DoubleConv, HarmonicLayerNorm,
                     TransformerEncLayer, init_parameters, max_pool2d,
                     pitch_head)
from .port import state_dict_from_flax
from .unets import SimpleUNetDoubleSelfAttn
