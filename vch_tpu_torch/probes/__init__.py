"""Kernel cost probes of the port: counterparts of vch_tpu's TPU probes
under scripts/, run on the CUDA card."""
