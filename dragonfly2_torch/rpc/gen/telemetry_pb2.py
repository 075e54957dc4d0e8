# -*- coding: utf-8 -*-
# Generated by hack/gen_telemetry_pb2.py (no protoc in this image).
# source: telemetry.proto — DO NOT EDIT BY HAND; edit the proto and rerun.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0ftelemetry.proto\x12\x18dragonfly2_tpu.telemetry"\xc7\x01\n\x0fTelemetryReport\x12\x18\n\x07service\x18\x01 \x01(\tR\x07service\x12\x1a\n\x08instance\x18\x02 \x01(\tR\x08instance\x12\x14\n\x05shard\x18\x03 \x01(\tR\x05shard\x12\x14\n\x05epoch\x18\x04 \x01(\tR\x05epoch\x12\x10\n\x03seq\x18\x05 \x01(\x04R\x03seq\x12\x1d\n\ninterval_s\x18\x06 \x01(\x01R\tintervalS\x12!\n\x0cpayload_json\x18\x07 \x01(\tR\x0bpayloadJson"I\n\x0cTelemetryAck\x12\x1e\n\nregistered\x18\x01 \x01(\x08R\nregistered\x12\x19\n\x08last_seq\x18\x02 \x01(\x04R\x07lastSeq2q\n\tTelemetry\x12d\n\x0fReportTelemetry\x12).dragonfly2_tpu.telemetry.TelemetryReport\x1a&.dragonfly2_tpu.telemetry.TelemetryAckb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'telemetry_pb2', globals())
