"""Config and file-list readers, and the S3 download behind ``s3://`` paths.

A copy of what the port uses of ``pfann_tpu/utils/config.py``, so that the
port imports nothing of the JAX package.  Parity target: reference
simpleutils.py:30-70 (read_config, read_file_list, S3 download).  JSON
config files use the same schema as the reference's configs/*.json.
"""

from __future__ import annotations

import csv
import json
import os
import tempfile
from typing import Any


def read_config(path: str) -> dict[str, Any]:
    """Load a JSON config file (simpleutils.py:30-32)."""
    with open(path, "r") as fin:
        return json.load(fin)


def write_config(params: dict[str, Any], path: str) -> None:
    with open(path, "w") as fout:
        json.dump(params, fout, indent=2)


_s3_resource = None


def get_s3_resource(endpoint_url: str | None = None):
    """Lazily constructed boto3 S3 resource (simpleutils.py:49-55); gated
    on boto3 being importable."""
    global _s3_resource
    if _s3_resource is None:
        import boto3

        _s3_resource = boto3.resource("s3", endpoint_url=endpoint_url)
    return _s3_resource


def download_tmp_from_s3(s3url: str) -> str:
    """Download s3://bucket/key to a temp file; returns the path
    (simpleutils.py:57-70)."""
    s3_res = get_s3_resource()
    d1 = s3url.find("/", 5)
    bucket_name, object_name = s3url[5:d1], s3url[d1 + 1 :]
    ext = os.path.splitext(s3url)[1]
    obj = s3_res.Object(bucket_name, object_name)
    fd, tmpname = tempfile.mkstemp(suffix=ext, prefix="pfann")
    os.close(fd)
    try:
        obj.download_file(tmpname)
        return tmpname
    except Exception as x:
        os.unlink(tmpname)
        raise RuntimeError("Unable to download %s: %s" % (s3url, x))


def read_file_list(list_file: str) -> list[str]:
    """Read a file list: .csv (first column, header skipped) or plain txt
    (one path per line).  Parity: simpleutils.py:34-47."""
    files: list[str] = []
    if list_file.endswith(".csv"):
        with open(list_file, "r") as fin:
            reader = csv.reader(fin)
            next(reader)  # header row
            files = [row[0] for row in reader]
    else:
        with open(list_file, "r", encoding="utf8") as fin:
            for line in fin:
                if line.endswith("\n"):
                    line = line[:-1]
                files.append(line)
    return files
