"""The plain reference: plain PyTorch and numpy, float32 with TF32 off.
It imports neither JAX, the JAX package nor anything of the program."""
