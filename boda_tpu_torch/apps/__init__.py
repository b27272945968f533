"""Applications on the engine: image preprocessing."""
