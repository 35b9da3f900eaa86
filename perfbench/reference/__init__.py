"""Plain PyTorch references, one file per ``model_type`` of a configuration
file: float32, TF32 off, no code of the program."""
