"""Host-side helpers: parameter conversion from the JAX package and the
phoneme tokenizers."""
