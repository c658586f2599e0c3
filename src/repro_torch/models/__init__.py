"""The port's LM model stack: parameters, layers, attention, and the
dense decoder family (``transformer``)."""
