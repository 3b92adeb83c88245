from .layers import (ConvBlock, DoubleConv, HarmonicLayerNorm,
                     TransformerEncLayer, init_parameters,
                     init_parameters_flax, max_pool2d,
                     pitch_head)
from .port import state_dict_from_flax, torch_module_name
from .unets import SimpleUNetDoubleSelfAttn
