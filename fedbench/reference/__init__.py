"""Plain PyTorch references the benchmark judges the port against: one
module per model family (``moe``, ``ssm``: the weights a cell trains from,
the loss, the model FLOPs) and one per federated algorithm (``fedcet``).
They import nothing of the port."""
