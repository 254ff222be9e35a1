"""Traffic mixes as data, and the one generator that reads them."""
