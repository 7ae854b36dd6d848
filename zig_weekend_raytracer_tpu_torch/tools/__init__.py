"""Command-line tools of the port that measure the card (``fp32_peak``)."""
