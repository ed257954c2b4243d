"""The benchmark's plain reference decoder (``decoder.py``): frozen copies
of the encoder port's decode-side modules (bitstream and header parsers,
the CABAC decoder and CTU syntax, motion-vector prediction, the numpy
recon, deblocking and SAO in plain torch), trimmed to what the decoder
reaches.  The module docstrings are the originals'.  Nothing here imports
the program."""
