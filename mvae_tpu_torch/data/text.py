"""MultiMNIST digit-string codec (the port's copy of mvae_tpu/data/text.py;
reference multimnist/utils.py:12-57).

The alphabet is '0123456789' plus SOS (10) and FILL (11); strings are
fixed length 4, FILL-padded (no EOS). '^' renders SOS; FILL renders as
nothing.
"""

import numpy as np

MAX_LENGTH = 4
ALPHABET = "0123456789"
SOS = len(ALPHABET)          # 10
FILL = len(ALPHABET) + 1     # 11
N_CHARACTERS = len(ALPHABET) + 2


def encode_string(s: str) -> np.ndarray:
    if len(s) > MAX_LENGTH:
        raise ValueError(f"{s!r} is longer than {MAX_LENGTH} characters")
    out = np.full(MAX_LENGTH, FILL, np.int32)
    for i, c in enumerate(s):
        out[i] = ALPHABET.index(c)
    return out


def encode_digit_list(digits) -> np.ndarray:
    return encode_string("".join(str(int(d)) for d in digits))


def decode_tokens(tokens) -> str:
    out = []
    for t in np.asarray(tokens).tolist():
        if t == SOS:
            out.append("^")
        elif t != FILL:
            out.append(ALPHABET[int(t)])
    return "".join(out)
