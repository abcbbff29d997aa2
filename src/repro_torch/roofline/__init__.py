"""Roofline of the port on one H100: ``counter`` counts a step's work on an
executed run or on meta tensors, ``report`` prices it with the card's
peaks, ``tables`` renders the dry run's artifacts."""
