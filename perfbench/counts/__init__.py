"""The yardsticks: the card's peaks, the kernels' work and least times,
the model's operations."""
