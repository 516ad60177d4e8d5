"""The eager tensor ops of the control update."""
