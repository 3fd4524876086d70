"""Sample models of the port (the counterpart of
``veles_tpu.znicz.samples``)."""
