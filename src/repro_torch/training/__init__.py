"""Training of the port: AdamW (``optimizer.py``) and the train step
(``train_step.py``), counterparts of src/repro/training/."""
