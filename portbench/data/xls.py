"""Minimal reader for legacy Excel .xls files (OLE2 + BIFF8), frozen here
so that the benchmark reads GoogleStock the same way whatever later
changes the program makes to its own reader.

The reference reads its bundled GoogleStock workbook through `xlrd`
(dataset.py:392-401).  xlrd is not part of this framework's dependency
budget, so this module implements the small slice of the format the data
layer needs, from the file-format specs:

  * the OLE2/CFB container (sector FAT walk, directory, mini-stream),
  * the BIFF8 record stream of the first worksheet substream,
  * numeric cell records NUMBER / RK / MULRK / FORMULA and shared strings
    (SST/LABELSST) for header cells.

It exposes `open_workbook(path).sheet_by_index(0).cell_value(r, c)` —
deliberately xlrd-shaped so golden-generation tooling can inject it as a
drop-in stand-in.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

_OLE_MAGIC = b'\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1'
_FREESECT = 0xFFFFFFFF
_ENDOFCHAIN = 0xFFFFFFFE
_FATSECT = 0xFFFFFFFD
_DIFSECT = 0xFFFFFFFC

CellValue = Union[float, str, None]


class Sheet:
    def __init__(self, name: str) -> None:
        self.name = name
        self._cells: Dict[int, Dict[int, CellValue]] = {}
        self.nrows = 0
        self.ncols = 0

    def _put(self, row: int, col: int, value: CellValue) -> None:
        self._cells.setdefault(row, {})[col] = value
        self.nrows = max(self.nrows, row + 1)
        self.ncols = max(self.ncols, col + 1)

    def cell_value(self, row: int, col: int) -> CellValue:
        return self._cells.get(row, {}).get(col, '')


class Workbook:
    def __init__(self, sheets: List[Sheet]) -> None:
        self.sheets = sheets

    def sheet_by_index(self, idx: int) -> Sheet:
        return self.sheets[idx]

    def sheet_names(self) -> List[str]:
        return [s.name for s in self.sheets]


def _read_ole_stream(data: bytes, stream_names: tuple) -> bytes:
    """Extract a named stream ('Workbook' or 'Book') from an OLE2 container."""
    if data[:8] != _OLE_MAGIC:
        raise ValueError('not an OLE2 compound file')
    sector_shift = struct.unpack_from('<H', data, 30)[0]
    mini_shift = struct.unpack_from('<H', data, 32)[0]
    sec_size = 1 << sector_shift
    mini_size = 1 << mini_shift
    num_fat = struct.unpack_from('<I', data, 44)[0]
    dir_start = struct.unpack_from('<I', data, 48)[0]
    mini_cutoff = struct.unpack_from('<I', data, 56)[0]
    minifat_start = struct.unpack_from('<I', data, 60)[0]
    difat_start = struct.unpack_from('<I', data, 68)[0]
    num_difat = struct.unpack_from('<I', data, 72)[0]

    def sector(n: int) -> bytes:
        off = 512 + n * sec_size
        return data[off:off + sec_size]

    # DIFAT: 109 entries in the header + chained DIFAT sectors.
    difat = list(struct.unpack_from('<109I', data, 76))
    nxt = difat_start
    for _ in range(num_difat):
        sec = sector(nxt)
        entries = struct.unpack(f'<{sec_size // 4}I', sec)
        difat.extend(entries[:-1])
        nxt = entries[-1]
    fat_sectors = [s for s in difat[:num_fat + len(difat)] if s not in
                   (_FREESECT, _ENDOFCHAIN, _FATSECT, _DIFSECT)][:num_fat]

    fat: List[int] = []
    for s in fat_sectors:
        fat.extend(struct.unpack(f'<{sec_size // 4}I', sector(s)))

    def chain(start: int) -> bytes:
        out, n, guard = [], start, 0
        while n != _ENDOFCHAIN and n != _FREESECT:
            out.append(sector(n))
            n = fat[n]
            guard += 1
            if guard > len(fat) + 2:
                raise ValueError('corrupt FAT chain')
        return b''.join(out)

    directory = chain(dir_start)

    streams = {}
    root_start = root_size = None
    for off in range(0, len(directory), 128):
        entry = directory[off:off + 128]
        if len(entry) < 128:
            break
        name_len = struct.unpack_from('<H', entry, 64)[0]
        if name_len < 2:
            continue
        name = entry[:name_len - 2].decode('utf-16-le', errors='replace')
        obj_type = entry[66]
        start = struct.unpack_from('<I', entry, 116)[0]
        size = struct.unpack_from('<I', entry, 120)[0]
        if obj_type == 5:  # root entry holds the mini stream
            root_start, root_size = start, size
        elif obj_type == 2:
            streams[name] = (start, size)

    for want in stream_names:
        if want in streams:
            start, size = streams[want]
            break
    else:
        raise ValueError(f'no stream named {stream_names} in {list(streams)}')

    if size >= mini_cutoff:
        return chain(start)[:size]

    # Small stream: walk the mini FAT inside the root entry's mini stream.
    mini_stream = chain(root_start)[:root_size]
    minifat: List[int] = []
    n = minifat_start
    while n != _ENDOFCHAIN and n != _FREESECT:
        minifat.extend(struct.unpack(f'<{sec_size // 4}I', sector(n)))
        n = fat[n]
    out, n, guard = [], start, 0
    while n != _ENDOFCHAIN and n != _FREESECT:
        out.append(mini_stream[n * mini_size:(n + 1) * mini_size])
        n = minifat[n]
        guard += 1
        if guard > len(minifat) + 2:
            raise ValueError('corrupt miniFAT chain')
    return b''.join(out)[:size]


def _decode_rk(raw: int) -> float:
    cents = raw & 0x01
    if raw & 0x02:  # 30-bit signed integer
        val = raw >> 2
        if val & 0x20000000:
            val -= 0x40000000
        val = float(val)
    else:  # top 30 bits of an IEEE double
        val = struct.unpack('<d', struct.pack('<Q', (raw & 0xFFFFFFFC) << 32))[0]
    return val / 100.0 if cents else val


def _parse_sst(payload: bytes) -> List[str]:
    """Parse the shared-string table (record 0x00FC, continued by 0x003C).

    `payload` must be the concatenated SST+CONTINUE data with a marker byte
    0x00/0x01 re-inserted at continue boundaries by the caller; for
    simplicity we parse leniently and bail out (returning what we have) on
    boundary complications — numeric loaders never need full fidelity.
    """
    strings: List[str] = []
    try:
        total, unique = struct.unpack_from('<II', payload, 0)
        pos = 8
        for _ in range(unique):
            if pos + 3 > len(payload):
                break
            nchars, flags = struct.unpack_from('<HB', payload, pos)
            pos += 3
            rich = flags & 0x08
            ext = flags & 0x04
            nrich = next = 0
            if rich:
                nrich = struct.unpack_from('<H', payload, pos)[0]
                pos += 2
            if ext:
                next = struct.unpack_from('<I', payload, pos)[0]
                pos += 4
            if flags & 0x01:
                raw = payload[pos:pos + 2 * nchars]
                strings.append(raw.decode('utf-16-le', errors='replace'))
                pos += 2 * nchars
            else:
                raw = payload[pos:pos + nchars]
                strings.append(raw.decode('latin-1'))
                pos += nchars
            pos += 4 * nrich + next
    except struct.error:
        pass
    return strings


def parse_biff(stream: bytes) -> List[Sheet]:
    """Parse every worksheet substream of a BIFF8 workbook stream."""
    sheets: List[Sheet] = []
    sst: List[str] = []
    sheet_names: List[str] = []
    current: Sheet | None = None
    in_globals = True
    pos = 0
    sst_payload = bytearray()
    collecting_sst = False
    n = len(stream)
    while pos + 4 <= n:
        opcode, length = struct.unpack_from('<HH', stream, pos)
        payload = stream[pos + 4:pos + 4 + length]
        pos += 4 + length
        if opcode == 0x0809:  # BOF
            substream_type = struct.unpack_from('<H', payload, 2)[0]
            if substream_type == 0x0005:
                in_globals = True
            elif substream_type == 0x0010:  # worksheet
                in_globals = False
                name = (sheet_names[len(sheets)]
                        if len(sheets) < len(sheet_names) else f'Sheet{len(sheets)}')
                current = Sheet(name)
                sheets.append(current)
            else:
                in_globals = False
                current = None
        elif opcode == 0x000A:  # EOF
            if collecting_sst:
                sst = _parse_sst(bytes(sst_payload))
                collecting_sst = False
            current = None
        elif opcode == 0x0085 and in_globals:  # BOUNDSHEET
            name_len = payload[6]
            flags = payload[7]
            raw = payload[8:]
            if flags & 0x01:
                sheet_names.append(raw[:2 * name_len].decode('utf-16-le', 'replace'))
            else:
                sheet_names.append(raw[:name_len].decode('latin-1'))
        elif opcode == 0x00FC and in_globals:  # SST
            sst_payload = bytearray(payload)
            collecting_sst = True
            continue
        elif opcode == 0x003C and collecting_sst:  # CONTINUE of SST
            # Skip the leading option byte of a continued string run.
            sst_payload.extend(payload[1:])
            continue
        elif current is not None:
            if opcode == 0x0203 and length >= 14:  # NUMBER
                row, col = struct.unpack_from('<HH', payload, 0)
                current._put(row, col, struct.unpack_from('<d', payload, 6)[0])
            elif opcode == 0x027E and length >= 10:  # RK
                row, col = struct.unpack_from('<HH', payload, 0)
                rk = struct.unpack_from('<I', payload, 6)[0]
                current._put(row, col, _decode_rk(rk))
            elif opcode == 0x00BD:  # MULRK
                row, first_col = struct.unpack_from('<HH', payload, 0)
                last_col = struct.unpack_from('<H', payload, length - 2)[0]
                for k in range(last_col - first_col + 1):
                    rk = struct.unpack_from('<I', payload, 4 + 6 * k + 2)[0]
                    current._put(row, first_col + k, _decode_rk(rk))
            elif opcode == 0x0006 and length >= 14:  # FORMULA (cached result)
                row, col = struct.unpack_from('<HH', payload, 0)
                raw = payload[6:14]
                if raw[6:8] == b'\xff\xff':
                    current._put(row, col, None)
                else:
                    current._put(row, col, struct.unpack('<d', raw)[0])
            elif opcode == 0x00FD and length >= 10:  # LABELSST
                row, col = struct.unpack_from('<HH', payload, 0)
                idx = struct.unpack_from('<I', payload, 6)[0]
                current._put(row, col, sst[idx] if idx < len(sst) else '')
            elif opcode == 0x0204 and length >= 9:  # LABEL (BIFF7 style)
                row, col = struct.unpack_from('<HH', payload, 0)
                slen = struct.unpack_from('<H', payload, 6)[0]
                current._put(row, col, payload[8:8 + slen].decode('latin-1'))
        if collecting_sst and opcode not in (0x00FC, 0x003C):
            sst = _parse_sst(bytes(sst_payload))
            collecting_sst = False
    return sheets


def open_workbook(path: str) -> Workbook:
    with open(path, 'rb') as f:
        data = f.read()
    stream = _read_ole_stream(data, ('Workbook', 'Book'))
    sheets = parse_biff(stream)
    if not sheets:
        raise ValueError(f'no worksheets found in {path}')
    return Workbook(sheets)
