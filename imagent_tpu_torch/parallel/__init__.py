"""Data parallelism across processes (PyTorch port of
``imagent_tpu/parallel/``): the collectives of the train and eval steps."""
