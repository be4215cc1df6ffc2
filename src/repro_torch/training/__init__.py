"""Training of the port: AdamW and its schedules (``optimizer``) and the
fault-tolerant ``Trainer`` (``train_loop``)."""
