"""The benchmark of sqtpu_torch on the card: ``python3 -m perfbench.run``."""
