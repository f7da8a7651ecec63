"""The plain reference: the spectrum and its gradient in plain torch,
worked out from the input files alone."""
