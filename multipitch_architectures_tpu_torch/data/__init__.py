from .augment import (AugmentConfig, apply_augment, apply_eq, apply_noise,
                      apply_time_scale, apply_transposition, apply_tuning,
                      augment_batch, augment_one, draw_augment, draw_eq,
                      draw_noise, draw_time_scale, draw_transposition,
                      draw_tuning, log_compress, random_eq, random_noise,
                      random_transposition, random_tuning_shift, time_scale)
from .pipeline import FileSpec, TrainPipeline, fold_in
from .windows import (gather_targets, gather_windows, num_segments,
                      num_windows, window_centers)
