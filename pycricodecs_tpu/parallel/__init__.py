"""Batched + multi-device decode/encode pipelines."""
from .pipeline import (DecodeStats, adx_decode_batch, adx_encode_batch,
                       ahx_decode_batch, ahx_encode_batch,
                       decode_acb, decode_awb, decode_batch, encode_batch,
                       find_key, hca_encode_batch, make_mesh,
                       pick_hca_engine, rank_keys, trace)

__all__ = ["DecodeStats", "decode_batch", "decode_awb", "decode_acb",
           "adx_decode_batch", "adx_encode_batch", "ahx_decode_batch",
           "ahx_encode_batch", "encode_batch",
           "find_key", "hca_encode_batch", "make_mesh",
           "pick_hca_engine", "rank_keys", "trace"]
