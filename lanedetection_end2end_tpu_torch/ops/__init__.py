"""Plain tensor ops and the hand-written kernel wrappers of the port."""
