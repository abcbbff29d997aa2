"""Training for the port: AdamW with its schedules (``optimizer``), the
binary-connect retraining of beacons (``qat``), training checkpoints
(``checkpoint``), the LM trainer's step functions (``train_step``) and int8
error-feedback gradient compression (``grad_compress``)."""
