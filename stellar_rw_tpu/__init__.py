"""Second-order random-walk (node2vec) + skip-gram embedding framework in JAX."""

__version__ = "0.1.0"
