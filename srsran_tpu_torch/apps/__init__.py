"""Entry points a user runs: the gNB simulator (``python -m srsran_tpu_torch.apps.gnb_sim``)."""
