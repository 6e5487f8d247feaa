"""The plain reference the program is judged by: frozen copies of the
port's plain ops, ResNetSQ written plainly, the training step with Adam,
and the scoring. It imports nothing of the program."""
