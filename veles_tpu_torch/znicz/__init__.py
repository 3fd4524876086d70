"""Neural-network functions of the port (the counterpart of
``veles_tpu.znicz``): the decode face of the flagship model and the two
kernel modules it runs through."""
