"""Training for the port: AdamW with its schedules (``optimizer``) and the
binary-connect retraining of beacons (``qat``)."""
