"""Binary blob stores — the DFG FolderStore / addBlobStore! analogue
(counterpart of ``rome_tpu/io/blobstore.py``, pure Python, copied: a test
holds the two to the same behaviour).

The reference attaches large binary payloads (DEM tiles, images, point
clouds, raw odometry ticks) to variables through a blob side channel instead
of inlining them in the graph document (testScalarFields.jl:68-70
``FolderStore`` + ``addBlobStore!``; DFG ``addData!``/``getData``):

- :class:`FolderStore` — one file per blob under a folder (+ JSON metadata);
- :class:`InMemoryStore` — dict-backed store for tests/ephemeral use;
- :func:`add_blob_store` / :func:`add_data` / :func:`get_data` /
  :func:`list_data_entries` / :func:`delete_data` — graph-level API; entries
  (id, label, mime, size, sha256) are recorded on the variable and survive
  ``save_dfg`` / ``load_dfg`` as REFERENCES (payloads stay in the store).
"""

from __future__ import annotations

import hashlib
import json
import os
import uuid
from dataclasses import asdict, dataclass


@dataclass
class BlobEntry:
    """Reference to a stored blob (DFG BlobEntry analogue)."""

    blob_id: str
    label: str
    store: str
    mime: str = "application/octet-stream"
    size: int = 0
    sha256: str = ""

    def to_doc(self):
        return asdict(self)

    @classmethod
    def from_doc(cls, doc):
        return cls(**doc)


class InMemoryStore:
    """Ephemeral blob store (tests, scratch sessions)."""

    def __init__(self, key: str = "default_mem_store"):
        self.key = key
        self._blobs: dict = {}

    def put(self, blob_id: str, data: bytes, meta: dict = None):
        self._blobs[blob_id] = bytes(data)

    def get(self, blob_id: str) -> bytes:
        return self._blobs[blob_id]

    def has(self, blob_id: str) -> bool:
        return blob_id in self._blobs

    def delete(self, blob_id: str):
        self._blobs.pop(blob_id, None)


class FolderStore:
    """One file per blob under ``folder`` (FolderStore{Vector{UInt8}}
    analogue): ``<blob_id>.blob`` payload + ``<blob_id>.json`` metadata."""

    def __init__(self, key: str = "default_folder_store", folder: str = "."):
        self.key = key
        self.folder = folder
        os.makedirs(folder, exist_ok=True)

    def _path(self, blob_id: str, ext: str = "blob"):
        return os.path.join(self.folder, f"{blob_id}.{ext}")

    def put(self, blob_id: str, data: bytes, meta: dict = None):
        with open(self._path(blob_id), "wb") as fh:
            fh.write(data)
        if meta:
            with open(self._path(blob_id, "json"), "w") as fh:
                json.dump(meta, fh)

    def get(self, blob_id: str) -> bytes:
        with open(self._path(blob_id), "rb") as fh:
            return fh.read()

    def has(self, blob_id: str) -> bool:
        return os.path.exists(self._path(blob_id))

    def delete(self, blob_id: str):
        for ext in ("blob", "json"):
            p = self._path(blob_id, ext)
            if os.path.exists(p):
                os.remove(p)


def add_blob_store(fg, store):
    """addBlobStore! analogue: register a store on the graph."""
    if not hasattr(fg, "_blob_stores"):
        fg._blob_stores = {}
    fg._blob_stores[store.key] = store
    return store


def get_blob_store(fg, key: str = None):
    stores = getattr(fg, "_blob_stores", {})
    if not stores:
        raise KeyError("graph has no blob store (add_blob_store first)")
    if key is None:
        key = next(iter(stores))
    return stores[key]


def _entries_of(fg, var_label):
    rec = fg.variables[var_label]
    if not hasattr(rec, "data_entries"):
        rec.data_entries = {}
    return rec.data_entries


def add_data(fg, var_label: str, data_label: str, data: bytes,
             mime: str = "application/octet-stream", store_key: str = None):
    """addData! analogue: store bytes, record a BlobEntry on the variable."""
    store = get_blob_store(fg, store_key)
    blob_id = str(uuid.uuid4())
    data = bytes(data)
    entry = BlobEntry(
        blob_id=blob_id, label=data_label, store=store.key, mime=mime,
        size=len(data), sha256=hashlib.sha256(data).hexdigest(),
    )
    store.put(blob_id, data, meta=entry.to_doc() if isinstance(
        store, FolderStore) else None)
    _entries_of(fg, var_label)[data_label] = entry
    return entry


def get_data(fg, var_label: str, data_label: str):
    """getData analogue: returns (entry, bytes); verifies the checksum."""
    entry = _entries_of(fg, var_label)[data_label]
    store = get_blob_store(fg, entry.store)
    data = store.get(entry.blob_id)
    if entry.sha256 and hashlib.sha256(data).hexdigest() != entry.sha256:
        raise IOError(
            f"blob {entry.blob_id} checksum mismatch for {var_label}/{data_label}"
        )
    return entry, data


def list_data_entries(fg, var_label: str):
    """listDataEntries analogue."""
    return sorted(_entries_of(fg, var_label))


def delete_data(fg, var_label: str, data_label: str):
    entry = _entries_of(fg, var_label).pop(data_label)
    store = get_blob_store(fg, entry.store)
    store.delete(entry.blob_id)
    return entry


# reference-style aliases
addBlobStore = add_blob_store
addData = add_data
getData = get_data
listDataEntries = list_data_entries
