"""The port's benchmark."""
