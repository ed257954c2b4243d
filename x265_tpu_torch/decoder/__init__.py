from .decoder import DecodedPicture, DecodeError, Decoder, decode_annexb

__all__ = ["DecodedPicture", "DecodeError", "Decoder", "decode_annexb"]
