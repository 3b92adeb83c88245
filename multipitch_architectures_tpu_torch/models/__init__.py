from .cnns import (BasicCnn, BasicCnnPool, BasicCnnSegmBlankLogSoftmax,
                   BasicCnnSegmLogSoftmax, BasicCnnSegmSigmoid,
                   DeepCnnSegmSigmoid)
from .layers import (BLSTMTemporalEncLayer, ConvBlock, DoubleConv,
                     HarmonicLayerNorm, PitchHead, SingleConvSELU,
                     TransformerEncLayer, TransformerTemporalEncLayer,
                     init_parameters, init_parameters_flax, leaky_relu,
                     max_pool2d, max_pool_with_indices_freq, max_unpool_freq,
                     pitch_head, polyphony_head)
from .port import state_dict_from_flax, torch_module_name
from .unets import (FreqUNet, FreqUNetBottomStack, FreqUNetDoubleSelfAttn,
                    FreqUNetSelfAttn, SimpleUNet, SimpleUNetDoubleSelfAttn,
                    SimpleUNetDoubleSelfAttnAllLayers,
                    SimpleUNetDoubleSelfAttnPolyphony,
                    SimpleUNetDoubleSelfAttnPolyphonyClassif,
                    SimpleUNetDoubleSelfAttnTransEnc,
                    SimpleUNetDoubleSelfAttnTwoLayers,
                    SimpleUNetDoubleSelfAttnVarLayers,
                    SimpleUNetLargeKernels, SimpleUNetPolyphonyClassif,
                    SimpleUNetPolyphonyClassifSoftmax, SimpleUNetSelfAttn,
                    SimpleUNetSixSelfAttn, UNetBlstmVarLayers,
                    UNetTemporalBlstmVarLayers, UNetTemporalSelfAttnVarLayers)

# the reference's snake_case names (libdl/nn_models/__init__.py)
basic_cnn = BasicCnn
basic_cnn_pool = BasicCnnPool
basic_cnn_segm_sigmoid = BasicCnnSegmSigmoid
basic_cnn_segm_logsoftmax = BasicCnnSegmLogSoftmax
basic_cnn_segm_blank_logsoftmax = BasicCnnSegmBlankLogSoftmax
deep_cnn_segm_sigmoid = DeepCnnSegmSigmoid
simple_u_net = SimpleUNet
simple_u_net_largekernels = SimpleUNetLargeKernels
simple_u_net_selfattn = SimpleUNetSelfAttn
simple_u_net_doubleselfattn = SimpleUNetDoubleSelfAttn
simple_u_net_sixselfattn = SimpleUNetSixSelfAttn
simple_u_net_doubleselfattn_twolayers = SimpleUNetDoubleSelfAttnTwoLayers
simple_u_net_doubleselfattn_alllayers = SimpleUNetDoubleSelfAttnAllLayers
simple_u_net_doubleselfattn_varlayers = SimpleUNetDoubleSelfAttnVarLayers
u_net_blstm_varlayers = UNetBlstmVarLayers
u_net_temporal_selfattn_varlayers = UNetTemporalSelfAttnVarLayers
u_net_temporal_blstm_varlayers = UNetTemporalBlstmVarLayers
simple_u_net_doubleselfattn_transenc = SimpleUNetDoubleSelfAttnTransEnc
freq_u_net = FreqUNet
freq_u_net_bottomstack = FreqUNetBottomStack
freq_u_net_selfattn = FreqUNetSelfAttn
freq_u_net_doubleselfattn = FreqUNetDoubleSelfAttn
simple_u_net_doubleselfattn_polyphony = SimpleUNetDoubleSelfAttnPolyphony
simple_u_net_doubleselfattn_polyphony_classif = (
    SimpleUNetDoubleSelfAttnPolyphonyClassif)
simple_u_net_polyphony_classif = SimpleUNetPolyphonyClassif
simple_u_net_polyphony_classif_softmax = SimpleUNetPolyphonyClassifSoftmax

# the building blocks' names; ``single_conv`` is broken upstream
# (unet_cnns.py:13-27) and names the working single-stage block here, as
# in the JAX package
double_conv = DoubleConv
single_conv = SingleConvSELU
transformer_enc_layer = TransformerEncLayer
transformer_temporal_enc_layer = TransformerTemporalEncLayer
blstm_temporal_enc_layer = BLSTMTemporalEncLayer

from ..ops.resize import up_concat_pad as unet_up_concat_padding  # noqa: E402
