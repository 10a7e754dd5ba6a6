"""BFieldCodec: canonical field-element serialization.

Reconstructs the semantics of `twenty-first`'s BFieldCodec as used by the
reference for proofs (triton-vm/src/proof.rs:38,
proof_stream.rs:29-42):

  * BFE -> 1 word; XFE -> 3 words (c0,c1,c2); Digest -> 5 words; u32 -> 1
    word; fixed arrays -> concatenation.
  * Vec<T>: [number of items] then, per item, the item's encoding, preceded
    by its length in words if T has no static length.
  * Structs: fields in declaration order, each preceded by its encoding
    length if the field type has no static length.
  * Enums: [variant discriminant] then the variant's fields like a struct.

AUDIT(bit-exactness): the struct-field order and Vec length-prepending rules
follow the author's reading of twenty-first's derive macro; verify against
Rust-generated proofs when a Rust toolchain is available.
"""

from __future__ import annotations

from .bfe import P


class DecodeError(ValueError):
    pass


# value model: python data with declared shapes
# shape grammar:
#   "bfe" | "xfe" | "digest" | "u32" | ("vec", shape) | ("arr", n, shape)
#   | ("struct", [(name, shape), ...])


def static_length(shape):
    if shape == "bfe" or shape == "u32":
        return 1
    if shape == "xfe":
        return 3
    if shape == "digest":
        return 5
    if isinstance(shape, tuple):
        if shape[0] == "arr":
            inner = static_length(shape[2])
            return None if inner is None else shape[1] * inner
        if shape[0] == "vec":
            return None
        if shape[0] == "struct":
            total = 0
            for _, fshape in shape[1]:
                fl = static_length(fshape)
                if fl is None:
                    return None
                total += fl
            return total
    raise ValueError(f"unknown shape {shape!r}")


def encode(value, shape) -> list[int]:
    if shape == "bfe":
        return [value % P]
    if shape == "u32":
        assert 0 <= value < (1 << 32)
        return [value]
    if shape == "xfe":
        c0, c1, c2 = value
        return [c0 % P, c1 % P, c2 % P]
    if shape == "digest":
        assert len(value) == 5
        return [v % P for v in value]
    kind = shape[0]
    if kind == "arr":
        _, n, inner = shape
        assert len(value) == n
        out = []
        for item in value:
            out.extend(encode(item, inner))
        return out
    if kind == "vec":
        inner = shape[1]
        inner_static = static_length(inner)
        out = [len(value)]
        for item in value:
            item_enc = encode(item, inner)
            if inner_static is None:
                out.append(len(item_enc))
            out.extend(item_enc)
        return out
    if kind == "struct":
        out = []
        for fname, fshape in shape[1]:
            field_enc = encode(value[fname], fshape)
            if static_length(fshape) is None:
                out.append(len(field_enc))
            out.extend(field_enc)
        return out
    raise ValueError(f"unknown shape {shape!r}")


def decode(words, shape, pos=0):
    """Returns (value, new_pos)."""
    if shape == "bfe":
        _check(words, pos, 1)
        v = words[pos]
        if v >= P:
            raise DecodeError("non-canonical field element")
        return v, pos + 1
    if shape == "u32":
        _check(words, pos, 1)
        v = words[pos]
        if v >= 1 << 32:
            raise DecodeError("u32 out of range")
        return v, pos + 1
    if shape == "xfe":
        _check(words, pos, 3)
        vals = words[pos:pos + 3]
        if any(v >= P for v in vals):
            raise DecodeError("non-canonical field element")
        return tuple(vals), pos + 3
    if shape == "digest":
        _check(words, pos, 5)
        vals = words[pos:pos + 5]
        if any(v >= P for v in vals):
            raise DecodeError("non-canonical field element")
        return tuple(vals), pos + 5
    kind = shape[0]
    if kind == "arr":
        _, n, inner = shape
        out = []
        for _ in range(n):
            item, pos = decode(words, inner, pos)
            out.append(item)
        return out, pos
    if kind == "vec":
        inner = shape[1]
        inner_static = static_length(inner)
        _check(words, pos, 1)
        n = words[pos]
        pos += 1
        if n > len(words):
            raise DecodeError("vec length exceeds buffer")
        out = []
        for _ in range(n):
            if inner_static is None:
                _check(words, pos, 1)
                declared = words[pos]
                pos += 1
                item, new_pos = decode(words, inner, pos)
                if new_pos - pos != declared:
                    raise DecodeError("wrong declared item length")
                pos = new_pos
            else:
                item, pos = decode(words, inner, pos)
            out.append(item)
        return out, pos
    if kind == "struct":
        out = {}
        for fname, fshape in shape[1]:
            if static_length(fshape) is None:
                _check(words, pos, 1)
                declared = words[pos]
                pos += 1
                value, new_pos = decode(words, fshape, pos)
                if new_pos - pos != declared:
                    raise DecodeError("wrong declared field length")
                pos = new_pos
            else:
                value, pos = decode(words, fshape, pos)
            out[fname] = value
        return out, pos
    raise ValueError(f"unknown shape {shape!r}")


def _check(words, pos, n):
    if pos + n > len(words):
        raise DecodeError("buffer underrun")
