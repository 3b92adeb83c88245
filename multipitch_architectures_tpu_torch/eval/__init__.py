from .inference import (predict_dense, predict_dense_chunked,
                        predict_framewise)
from .measures import (calculate_eval_measures, calculate_single_measure,
                       compute_eval_measures, normalize_feature_sequence)
from .mireval import calculate_mpe_measures_mireval, midi_to_hz
from .quant import (DRIFT_GATE_MEASURES, Int8Conv2d, auto_hybrid_int8,
                    calibrate_activation_scales, calibrate_with_predictions,
                    eligible_convs, int8_drift_report, measure_drift,
                    predict_framewise_int8,
                    percentile_abs, quantize_convs, quantized_conv,
                    quantized_conv_static)
from .shared_inc import SharedIncForward, predict_framewise_shared
