from .windows import gather_windows, window_centers
