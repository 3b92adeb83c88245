from .configs import (MODEL_REGISTRY, ExperimentConfig, build_model,
                      load_experiment)
