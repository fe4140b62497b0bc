"""Traffic mixes (``<name>.json``, data) and the generator that reads them."""
