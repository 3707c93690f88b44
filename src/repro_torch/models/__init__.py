"""The port's model code: the dense transformer's serving path."""
