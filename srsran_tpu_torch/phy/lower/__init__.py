"""Lower PHY: the slot-clocked baseband sample engine and the PRACH
occasion demodulator (K21); the OFDM modulator and demodulator live in
ops/ofdm.py."""
