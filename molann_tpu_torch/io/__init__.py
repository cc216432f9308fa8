"""Model loading and trajectory reading for the port."""

from .reader import open_frame_reader  # noqa: F401
from .serialize import load_model, model_from_arrays  # noqa: F401
