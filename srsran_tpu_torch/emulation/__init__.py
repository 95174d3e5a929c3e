"""Emulation: the TDL fading channel (K20) that closes the UL loop of the
gNB simulator without radio hardware."""
