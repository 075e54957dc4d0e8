# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: common.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x63ommon.proto\x12\x15\x64ragonfly2_tpu.common\"\xd7\x01\n\x07UrlMeta\x12\x0e\n\x06\x64igest\x18\x01 \x01(\t\x12\x0b\n\x03tag\x18\x02 \x01(\t\x12\r\n\x05range\x18\x03 \x01(\t\x12\x0e\n\x06\x66ilter\x18\x04 \x01(\t\x12\x13\n\x0b\x61pplication\x18\x05 \x01(\t\x12\x10\n\x08priority\x18\x06 \x01(\x05\x12:\n\x06header\x18\x07 \x03(\x0b\x32*.dragonfly2_tpu.common.UrlMeta.HeaderEntry\x1a-\n\x0bHeaderEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"b\n\x07\x43puStat\x12\x15\n\rlogical_count\x18\x01 \x01(\r\x12\x16\n\x0ephysical_count\x18\x02 \x01(\r\x12\x0f\n\x07percent\x18\x03 \x01(\x01\x12\x17\n\x0fprocess_percent\x18\x04 \x01(\x01\"~\n\nMemoryStat\x12\r\n\x05total\x18\x01 \x01(\x04\x12\x11\n\tavailable\x18\x02 \x01(\x04\x12\x0c\n\x04used\x18\x03 \x01(\x04\x12\x14\n\x0cused_percent\x18\x04 \x01(\x01\x12\x1c\n\x14process_used_percent\x18\x05 \x01(\x01\x12\x0c\n\x04\x66ree\x18\x06 \x01(\x04\"o\n\x0bNetworkStat\x12\x1c\n\x14tcp_connection_count\x18\x01 \x01(\r\x12#\n\x1bupload_tcp_connection_count\x18\x02 \x01(\r\x12\x10\n\x08location\x18\x03 \x01(\t\x12\x0b\n\x03idc\x18\x04 \x01(\t\"\x93\x01\n\x08\x44iskStat\x12\r\n\x05total\x18\x01 \x01(\x04\x12\x0c\n\x04\x66ree\x18\x02 \x01(\x04\x12\x0c\n\x04used\x18\x03 \x01(\x04\x12\x14\n\x0cused_percent\x18\x04 \x01(\x01\x12\x14\n\x0cinodes_total\x18\x05 \x01(\x04\x12\x13\n\x0binodes_used\x18\x06 \x01(\x04\x12\x1b\n\x13inodes_used_percent\x18\x07 \x01(\x01\"\xd3\x03\n\x08HostInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x10\n\x08hostname\x18\x03 \x01(\t\x12\n\n\x02ip\x18\x04 \x01(\t\x12\x0c\n\x04port\x18\x05 \x01(\x05\x12\x15\n\rdownload_port\x18\x06 \x01(\x05\x12\n\n\x02os\x18\x07 \x01(\t\x12\x10\n\x08platform\x18\x08 \x01(\t\x12\x17\n\x0fplatform_family\x18\t \x01(\t\x12\x18\n\x10platform_version\x18\n \x01(\t\x12\x16\n\x0ekernel_version\x18\x0b \x01(\t\x12\x1f\n\x17\x63oncurrent_upload_limit\x18\x0c \x01(\x05\x12+\n\x03\x63pu\x18\r \x01(\x0b\x32\x1e.dragonfly2_tpu.common.CpuStat\x12\x31\n\x06memory\x18\x0e \x01(\x0b\x32!.dragonfly2_tpu.common.MemoryStat\x12\x33\n\x07network\x18\x0f \x01(\x0b\x32\".dragonfly2_tpu.common.NetworkStat\x12-\n\x04\x64isk\x18\x10 \x01(\x0b\x32\x1f.dragonfly2_tpu.common.DiskStat\x12\x1c\n\x14scheduler_cluster_id\x18\x11 \x01(\x03\"\x9c\x01\n\tPieceInfo\x12\x0e\n\x06number\x18\x01 \x01(\x05\x12\x11\n\tparent_id\x18\x02 \x01(\t\x12\x0e\n\x06offset\x18\x03 \x01(\x04\x12\x0e\n\x06length\x18\x04 \x01(\x04\x12\x0e\n\x06\x64igest\x18\x05 \x01(\t\x12\x14\n\x0ctraffic_type\x18\x06 \x01(\t\x12\x0f\n\x07\x63ost_ns\x18\x07 \x01(\x03\x12\x15\n\rcreated_at_ns\x18\x08 \x01(\x03*{\n\tSizeScope\x12\x16\n\x12SIZE_SCOPE_UNKNOWN\x10\x00\x12\x14\n\x10SIZE_SCOPE_EMPTY\x10\x01\x12\x13\n\x0fSIZE_SCOPE_TINY\x10\x02\x12\x14\n\x10SIZE_SCOPE_SMALL\x10\x03\x12\x15\n\x11SIZE_SCOPE_NORMAL\x10\x04*P\n\x08TaskType\x12\x16\n\x12TASK_TYPE_STANDARD\x10\x00\x12\x15\n\x11TASK_TYPE_DFSTORE\x10\x01\x12\x15\n\x11TASK_TYPE_DFCACHE\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _URLMETA_HEADERENTRY._options = None
  _URLMETA_HEADERENTRY._serialized_options = b'8\001'
  _SIZESCOPE._serialized_start=1377
  _SIZESCOPE._serialized_end=1500
  _TASKTYPE._serialized_start=1502
  _TASKTYPE._serialized_end=1582
  _URLMETA._serialized_start=40
  _URLMETA._serialized_end=255
  _URLMETA_HEADERENTRY._serialized_start=210
  _URLMETA_HEADERENTRY._serialized_end=255
  _CPUSTAT._serialized_start=257
  _CPUSTAT._serialized_end=355
  _MEMORYSTAT._serialized_start=357
  _MEMORYSTAT._serialized_end=483
  _NETWORKSTAT._serialized_start=485
  _NETWORKSTAT._serialized_end=596
  _DISKSTAT._serialized_start=599
  _DISKSTAT._serialized_end=746
  _HOSTINFO._serialized_start=749
  _HOSTINFO._serialized_end=1216
  _PIECEINFO._serialized_start=1219
  _PIECEINFO._serialized_end=1375
# @@protoc_insertion_point(module_scope)
