"""Plain PyTorch references that decide ``correct``.  They import nothing
of the program (``repro_torch``) and take nothing it made: weights,
batches and prompts are drawn again from the seed (``portbench.weights``,
``portbench.traffic``), and the program's outputs are read only to judge
them."""
