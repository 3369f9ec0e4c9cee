"""The plain reference of each configuration: `<config>.py` beside the
configuration's file's name, over a frozen copy of the port's plain
PyTorch versions (`frozen/`, imports rewritten, the kernels' wrappers
replaced by their plain versions). Nothing here imports the port, JAX or
the JAX package; it takes the benchmark's inputs and works out every
output again."""
