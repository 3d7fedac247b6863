"""Eval step of the port (the train step comes with the training slice)."""
