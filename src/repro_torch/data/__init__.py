"""Data of the port (port of ``src/repro/data/``): the paper's quadratic
problem and the synthetic heterogeneous LM streams."""
