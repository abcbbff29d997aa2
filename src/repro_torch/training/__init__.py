"""Training for the port: AdamW with its schedules (``optimizer``), the
binary-connect retraining of beacons (``qat``) and training checkpoints
(``checkpoint``)."""
