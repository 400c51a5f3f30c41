"""The plain reference the check holds the program to: a NumPy FLAC
encoder of one block (`encoder`), its DSP (`dsp`) and the bitstream
(`flac`). It imports nothing of the program, nor JAX."""
