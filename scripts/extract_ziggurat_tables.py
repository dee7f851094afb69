"""Write ``triple_hybrid_rag_tpu_torch/csrc/ziggurat_tables.cuh``: numpy's 64-bit
ziggurat tables for the standard normal (``ki_double``, ``wi_double``,
``fi_double``), copied bit for bit out of the installed numpy.

numpy keeps the tables as read-only data of ``numpy/random/lib/libnpyrandom.a``
(member ``*distributions.c.o``), where ``nm`` lists them. This script reads that
archive with the standard library alone (the ``ar`` format, then the ELF64
relocatable object's section and symbol tables) and writes each table as 256
64-bit patterns (the doubles as their IEEE bits), with numpy's license notice.
The BowHash draw kernel (``csrc/bowhash.cu``) and its plain version
(``ops/bowhash.py``) read that one header, so the repository needs nothing outside
it at run time. Run it once, from the root of the checkout:

    python3 scripts/extract_ziggurat_tables.py

(``tests/test_torch_bowhash.py`` holds the committed header to the installed numpy.)
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "triple_hybrid_rag_tpu_torch" / "csrc" / "ziggurat_tables.cuh"
TABLES = {"ki_double": "kZigKi", "wi_double": "kZigWiBits", "fi_double": "kZigFiBits"}
N = 256

NOTICE = """\
numpy/random (Copyright (c) 2019 Kevin Sheppard. All rights reserved.) is
distributed under the 3-Clause BSD License:

Redistribution and use in source and binary forms, with or without
modification, are permitted provided that the following conditions are met:

1. Redistributions of source code must retain the above copyright notice,
   this list of conditions and the following disclaimer.

2. Redistributions in binary form must reproduce the above copyright notice,
   this list of conditions and the following disclaimer in the documentation
   and/or other materials provided with the distribution.

3. Neither the name of the copyright holder nor the names of its contributors
   may be used to endorse or promote products derived from this software
   without specific prior written permission.

THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS IS"
AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO, THE
IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR PURPOSE
ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT HOLDER OR CONTRIBUTORS BE
LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL, EXEMPLARY, OR
CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO, PROCUREMENT OF
SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR PROFITS; OR BUSINESS
INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF LIABILITY, WHETHER IN
CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING NEGLIGENCE OR OTHERWISE)
ARISING IN ANY WAY OUT OF THE USE OF THIS SOFTWARE, EVEN IF ADVISED OF
THE POSSIBILITY OF SUCH DAMAGE."""


def ar_members(data: bytes):
    """(name, bytes) of each member of a System V / GNU ``ar`` archive."""
    if not data.startswith(b"!<arch>\n"):
        raise ValueError("not an ar archive")
    pos, longnames = 8, b""
    while pos + 60 <= len(data):
        head = data[pos:pos + 60]
        name, size = head[:16].decode().strip(), int(head[48:58].decode().strip())
        body = data[pos + 60:pos + 60 + size]
        if name == "//":
            longnames = body
        elif name.startswith("/") and name[1:].isdigit():
            off = int(name[1:])
            name = longnames[off:longnames.index(b"/\n", off)].decode()
        if name not in ("/", "//"):
            yield name.rstrip("/"), body
        pos += 60 + size + (size & 1)


def elf_symbols(obj: bytes):
    """name -> (bytes of the symbol) for the sized symbols of an ELF64
    little-endian relocatable object."""
    if obj[:4] != b"\x7fELF" or obj[4] != 2 or obj[5] != 1:
        raise ValueError("not an ELF64 little-endian object")
    shoff, = struct.unpack_from("<Q", obj, 0x28)
    shentsize, shnum, _ = struct.unpack_from("<HHH", obj, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", obj, shoff + i * shentsize) for i in range(shnum)]
    out = {}
    for sh in sections:
        if sh[1] != 2:  # SHT_SYMTAB
            continue
        strtab = sections[sh[6]]
        for off in range(sh[4], sh[4] + sh[5], sh[9]):
            st_name, _, _, st_shndx, st_value, st_size = struct.unpack_from("<IBBHQQ", obj, off)
            if not st_size or st_shndx == 0 or st_shndx >= len(sections):
                continue
            s = strtab[4] + st_name
            name = obj[s:obj.index(b"\0", s)].decode()
            target = sections[st_shndx]
            start = target[4] + st_value
            out[name] = obj[start:start + st_size]
    return out


def read_tables() -> dict:
    """numpy's three tables as lists of 256 unsigned 64-bit patterns."""
    lib = Path(np.random.__file__).parent / "lib" / "libnpyrandom.a"
    for name, body in ar_members(lib.read_bytes()):
        if not name.endswith("distributions.c.o"):
            continue
        syms = elf_symbols(body)
        if all(t in syms for t in TABLES):
            return {t: list(struct.unpack(f"<{N}Q", syms[t])) for t in TABLES}
    raise SystemExit(f"{lib}: no member holds {', '.join(TABLES)}")


def render(tables: dict) -> str:
    lines = [
        "// Generated by scripts/extract_ziggurat_tables.py: do not edit.",
        f"// numpy {np.__version__}'s 64-bit ziggurat tables for the standard normal,",
        "// copied bit for bit from numpy/random/lib/libnpyrandom.a (ki_double,",
        "// wi_double, fi_double); the doubles are stored as their IEEE-754 bit patterns.",
        "//",
        *[f"// {line}".rstrip() for line in NOTICE.splitlines()],
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
    ]
    for src, dst in TABLES.items():
        lines.append(f"// {src}")
        lines.append(f"__device__ const uint64_t {dst}[{N}] = {{")
        vals = tables[src]
        for i in range(0, N, 4):
            lines.append("    " + ", ".join(f"0x{v:016x}ULL" for v in vals[i:i + 4]) + ",")
        lines.append("};")
        lines.append("")
    return "\n".join(lines)


def main() -> int:
    OUT.write_text(render(read_tables()))
    print(f"wrote {OUT.relative_to(ROOT)} from numpy {np.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
