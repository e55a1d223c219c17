"""Golden NumPy/float64 oracle models for the JAX receiver (see dsp.py)."""
