from .cnns import BasicCnnSegmSigmoid, DeepCnnSegmSigmoid
from .layers import (BLSTMTemporalEncLayer, ConvBlock, DoubleConv,
                     HarmonicLayerNorm, PitchHead, TransformerEncLayer,
                     init_parameters, init_parameters_flax, max_pool2d,
                     pitch_head)
from .port import state_dict_from_flax, torch_module_name
from .unets import (SimpleUNetDoubleSelfAttn,
                    SimpleUNetDoubleSelfAttnTwoLayers,
                    SimpleUNetLargeKernels,
                    SimpleUNetPolyphonyClassifSoftmax, UNetBlstmVarLayers)

# the reference's snake_case names (libdl/nn_models/__init__.py)
basic_cnn_segm_sigmoid = BasicCnnSegmSigmoid
deep_cnn_segm_sigmoid = DeepCnnSegmSigmoid
simple_u_net_largekernels = SimpleUNetLargeKernels
simple_u_net_doubleselfattn = SimpleUNetDoubleSelfAttn
simple_u_net_doubleselfattn_twolayers = SimpleUNetDoubleSelfAttnTwoLayers
u_net_blstm_varlayers = UNetBlstmVarLayers
simple_u_net_polyphony_classif_softmax = SimpleUNetPolyphonyClassifSoftmax
double_conv = DoubleConv
transformer_enc_layer = TransformerEncLayer
blstm_temporal_enc_layer = BLSTMTemporalEncLayer

from ..ops.resize import up_concat_pad as unet_up_concat_padding  # noqa: E402
