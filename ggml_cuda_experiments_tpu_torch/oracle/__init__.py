"""NumPy specification of the port's quantization (``quant``)."""
