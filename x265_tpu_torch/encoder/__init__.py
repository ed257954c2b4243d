from .intra_encoder import Encoder, encode_sequence
