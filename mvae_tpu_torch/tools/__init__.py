"""Developer tools of the port (run on the machine with the card)."""
