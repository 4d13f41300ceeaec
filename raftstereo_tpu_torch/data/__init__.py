"""Host data pipeline of the port: own copies of the JAX package's numpy
readers, augmentors, synthetic data and loader."""
