"""FAPI-shaped slot messages, their validators and the slot conductor:
the deployment entry point of the port (port of srsran_tpu/fapi/)."""
