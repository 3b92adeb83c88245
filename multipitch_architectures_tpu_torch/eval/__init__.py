from .inference import predict_framewise
