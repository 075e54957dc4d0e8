# -*- coding: utf-8 -*-
# Generated by hack/gen_diagnose_pb2.py (no protoc in this image).
# source: diagnose.proto — DO NOT EDIT BY HAND; edit the proto and rerun.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0ediagnose.proto\x12\x17dragonfly2_tpu.diagnose"X\n\x0fDiagnoseRequest\x12\x1e\n\ncategories\x18\x01 \x03(\tR\ncategories\x12%\n\x0einclude_stacks\x18\x02 \x01(\x08R\rincludeStacks"c\n\x10DiagnoseResponse\x12\x18\n\x07service\x18\x01 \x01(\tR\x07service\x12\x10\n\x03pid\x18\x02 \x01(\x03R\x03pid\x12#\n\rsnapshot_json\x18\x03 \x01(\tR\x0csnapshotJson2k\n\x08Diagnose\x12_\n\x08Diagnose\x12(.dragonfly2_tpu.diagnose.DiagnoseRequest\x1a).dragonfly2_tpu.diagnose.DiagnoseResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'diagnose_pb2', globals())
