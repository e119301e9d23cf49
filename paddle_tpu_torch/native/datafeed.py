"""ctypes binding for datafeed.cc (MultiSlot parser) + Python fallback
(counterpart of paddle_tpu/native/datafeed.py, the same code over the
port's own build of the source).

Parity: framework/data_feed.h:208 MultiSlotDataFeed slot format.
"""
import ctypes

import numpy as np

from . import load_library

__all__ = ['parse_multislot']


def _parse_native(text, slot_types):
    lib = load_library('datafeed')
    lib.df_parse.restype = ctypes.c_void_p
    lib.df_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_void_p]
    lib.df_num_instances.restype = ctypes.c_int64
    lib.df_num_instances.argtypes = [ctypes.c_void_p]
    lib.df_slot_size.restype = ctypes.c_int64
    lib.df_slot_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for f in (lib.df_copy_slot_fvals, lib.df_copy_slot_ivals,
              lib.df_copy_slot_offsets):
        f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.df_free.argtypes = [ctypes.c_void_p]

    data = text.encode() if isinstance(text, str) else text
    types_arr = np.asarray([0 if t == 'float' else 1 for t in slot_types],
                           np.int32)
    h = lib.df_parse(data, len(data), len(slot_types), types_arr.ctypes.data)
    try:
        n_inst = lib.df_num_instances(h)
        slots = []
        for s, t in enumerate(slot_types):
            size = lib.df_slot_size(h, s)
            offsets = np.empty(n_inst + 1, np.int64)
            lib.df_copy_slot_offsets(h, s, offsets.ctypes.data)
            if t == 'float':
                vals = np.empty(size, np.float32)
                lib.df_copy_slot_fvals(h, s, vals.ctypes.data)
            else:
                vals = np.empty(size, np.int64)
                lib.df_copy_slot_ivals(h, s, vals.ctypes.data)
            slots.append((vals, offsets))
        return slots, int(n_inst)
    finally:
        lib.df_free(h)


def _parse_python(text, slot_types):
    n_slots = len(slot_types)
    vals = [[] for _ in range(n_slots)]
    offsets = [[0] for _ in range(n_slots)]
    n_inst = 0
    for line in text.splitlines():
        toks = line.split()
        pos = 0
        row = [[] for _ in range(n_slots)]
        ok = True
        for s in range(n_slots):
            if pos >= len(toks):
                ok = False
                break
            try:
                n = int(toks[pos])
            except ValueError:
                ok = False
                break
            pos += 1
            conv = float if slot_types[s] == 'float' else int
            try:
                row[s] = [conv(t) for t in toks[pos:pos + n]]
            except ValueError:
                ok = False
                break
            if len(row[s]) != n:
                ok = False
                break
            pos += n
        if not ok:
            continue
        for s in range(n_slots):
            vals[s].extend(row[s])
            offsets[s].append(len(vals[s]))
        n_inst += 1
    out = []
    for s, t in enumerate(slot_types):
        dt = np.float32 if t == 'float' else np.int64
        out.append((np.asarray(vals[s], dt), np.asarray(offsets[s], np.int64)))
    return out, n_inst


def parse_multislot(text, slot_types, force_python=False):
    """Parse MultiSlot text -> [(values, csr_offsets)] per slot + count."""
    if not force_python:
        try:
            return _parse_native(text, slot_types)
        except Exception:
            pass
    return _parse_python(text, slot_types)
