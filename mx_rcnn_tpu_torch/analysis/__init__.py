"""analysis of the PyTorch port (see the package docstring): the runtime
lock-order check the serve stack builds its locks with."""
