"""Published experimental data from the paper (oracles for tests/benches).

Table 3 — single-channel SSDs, way-interleaving sweep (MB/s).
Table 4 — constant-capacity channel/way trade-off (MB/s).
Table 5 — controller energy per transferred byte (nJ/B), SLC designs.

Columns are (CONV, SYNC_ONLY, PROPOSED) throughout.
"""

from __future__ import annotations

# --- Table 3: {cell: {mode: {ways: (C, S, P)}}} ---------------------------
TABLE3 = {
    "slc": {
        "write": {
            1: (7.77, 8.38, 8.50),
            2: (15.22, 16.59, 17.52),
            4: (28.94, 31.90, 34.30),
            8: (39.78, 55.36, 63.00),
            16: (39.76, 60.44, 97.35),
        },
        "read": {
            1: (27.78, 36.66, 47.89),
            2: (42.78, 67.16, 70.47),
            4: (42.75, 67.13, 117.68),
            8: (42.72, 67.11, 117.64),
            16: (42.69, 67.11, 117.59),
        },
    },
    "mlc": {
        "write": {
            1: (4.43, 4.55, 4.65),
            2: (8.36, 8.85, 9.24),
            4: (15.24, 16.75, 18.13),
            8: (25.86, 29.72, 34.08),
            16: (32.45, 45.99, 57.23),
        },
        "read": {
            1: (26.04, 33.58, 42.69),
            2: (41.59, 60.41, 77.19),
            4: (41.55, 64.76, 101.61),
            8: (41.52, 64.75, 110.56),
            16: (41.50, 64.73, 110.52),
        },
    },
}

# --- Table 4: {cell: {mode: {(channels, ways): (C, S, P)}}} ----------------
# "max" in the paper = hit the SATA2 cap (300 MB/s); encoded as None.
TABLE4 = {
    "slc": {
        "write": {
            (1, 16): (39.76, 60.44, 97.35),
            (2, 8): (74.07, 101.99, 114.83),
            (4, 4): (103.76, 115.68, 123.52),
        },
        "read": {
            (1, 16): (42.69, 67.11, 117.59),
            (2, 8): (81.44, 126.70, 224.82),
            (4, 4): (155.35, 237.61, None),
        },
    },
    "mlc": {
        "write": {
            (1, 16): (32.45, 45.99, 57.23),
            (2, 8): (48.72, 56.83, 64.75),
            (4, 4): (57.46, 63.55, 68.49),
        },
        "read": {
            (1, 16): (41.50, 64.73, 110.52),
            (2, 8): (79.32, 122.48, 201.42),
            (4, 4): (150.94, 230.17, None),
        },
    },
}

# --- Table 5: SLC energy per byte, nJ/B: {mode: {ways: (C, S, P)}} ---------
TABLE5 = {
    "write": {
        1: (2.90, 5.01, 5.47),
        2: (1.48, 2.53, 2.65),
        4: (0.78, 1.32, 1.36),
        8: (0.57, 0.76, 0.74),
        16: (0.57, 0.69, 0.48),
    },
    "read": {
        1: (0.81, 1.15, 0.97),
        2: (0.53, 0.63, 0.66),
        4: (0.53, 0.63, 0.40),
        8: (0.53, 0.63, 0.40),
        16: (0.53, 0.63, 0.40),
    },
}

# Headline speedup ranges from the abstract / §6 (PROPOSED over CONV).
CLAIMS = {
    ("slc", "read"): (1.65, 2.76),
    ("slc", "write"): (1.09, 2.45),
    ("mlc", "read"): (1.64, 2.66),
    ("mlc", "write"): (1.05, 1.76),
}

INTERFACE_ORDER = ("conv", "sync_only", "proposed")
