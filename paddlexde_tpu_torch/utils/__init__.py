from .norms import rms_norm  # noqa: F401
