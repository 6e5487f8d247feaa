"""Training of the port's models (counterpart of ``sqtpu/training``)."""
