"""Domain-adaptation methods built on the shared detector."""
