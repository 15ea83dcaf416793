"""The benchmark's air: a frozen copy of the TETRA downlink generator
(downlink) and the periodic wideband synthesis on the device (synth)."""
