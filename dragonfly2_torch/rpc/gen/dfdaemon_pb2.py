# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dfdaemon.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


# common.proto is registered through the port's own loader, never a flat
# import that could resolve to another package's copy
from dragonfly2_torch.rpc import protos as _protos  # noqa: E402

common__pb2 = _protos.load("common_pb2")


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0e\x64\x66\x64\x61\x65mon.proto\x12\x17\x64ragonfly2_tpu.dfdaemon\x1a\x0c\x63ommon.proto\"\x07\n\x05\x45mpty\"\xd0\x01\n\x0f\x44ownloadRequest\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x0e\n\x06output\x18\x02 \x01(\t\x12\x30\n\x08url_meta\x18\x03 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta\x12\x12\n\ntimeout_ns\x18\x04 \x01(\x04\x12\x1b\n\x13\x64isable_back_source\x18\x05 \x01(\x08\x12\x11\n\trecursive\x18\x06 \x01(\x08\x12\r\n\x05\x64\x65pth\x18\x07 \x01(\r\x12\x1b\n\x13need_back_to_source\x18\x08 \x01(\x08\"\x82\x01\n\x0e\x44ownloadResult\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07peer_id\x18\x02 \x01(\t\x12\x0c\n\x04\x64one\x18\x03 \x01(\x08\x12\x18\n\x10\x63ompleted_length\x18\x04 \x01(\x03\x12\x16\n\x0e\x63ontent_length\x18\x05 \x01(\x03\x12\x0e\n\x06output\x18\x06 \x01(\t\"o\n\x10PieceTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x13\n\x0bsrc_peer_id\x18\x02 \x01(\t\x12\x13\n\x0b\x64st_peer_id\x18\x03 \x01(\t\x12\x11\n\tstart_num\x18\x04 \x01(\r\x12\r\n\x05limit\x18\x05 \x01(\r\"\xca\x01\n\x0bPiecePacket\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x13\n\x0b\x64st_peer_id\x18\x02 \x01(\t\x12\x10\n\x08\x64st_addr\x18\x03 \x01(\t\x12\x35\n\x0bpiece_infos\x18\x04 \x03(\x0b\x32 .dragonfly2_tpu.common.PieceInfo\x12\x16\n\x0e\x63ontent_length\x18\x05 \x01(\x03\x12\x19\n\x11total_piece_count\x18\x06 \x01(\x05\x12\x19\n\x11piece_md5_sign_ok\x18\x07 \x01(\x08\"d\n\x0fStatTaskRequest\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x30\n\x08url_meta\x18\x02 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta\x12\x12\n\nlocal_only\x18\x03 \x01(\x08\"`\n\x11ImportTaskRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x30\n\x08url_meta\x18\x03 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta\"v\n\x11\x45xportTaskRequest\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x0e\n\x06output\x18\x02 \x01(\t\x12\x30\n\x08url_meta\x18\x03 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta\x12\x12\n\nlocal_only\x18\x04 \x01(\x08\"R\n\x11\x44\x65leteTaskRequest\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x30\n\x08url_meta\x18\x02 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta2\x98\x05\n\x08\x44\x66\x64\x61\x65mon\x12_\n\x08\x44ownload\x12(.dragonfly2_tpu.dfdaemon.DownloadRequest\x1a\'.dragonfly2_tpu.dfdaemon.DownloadResult0\x01\x12`\n\rGetPieceTasks\x12).dragonfly2_tpu.dfdaemon.PieceTaskRequest\x1a$.dragonfly2_tpu.dfdaemon.PiecePacket\x12\x65\n\x0eSyncPieceTasks\x12).dragonfly2_tpu.dfdaemon.PieceTaskRequest\x1a$.dragonfly2_tpu.dfdaemon.PiecePacket(\x01\x30\x01\x12T\n\x08StatTask\x12(.dragonfly2_tpu.dfdaemon.StatTaskRequest\x1a\x1e.dragonfly2_tpu.dfdaemon.Empty\x12X\n\nImportTask\x12*.dragonfly2_tpu.dfdaemon.ImportTaskRequest\x1a\x1e.dragonfly2_tpu.dfdaemon.Empty\x12X\n\nExportTask\x12*.dragonfly2_tpu.dfdaemon.ExportTaskRequest\x1a\x1e.dragonfly2_tpu.dfdaemon.Empty\x12X\n\nDeleteTask\x12*.dragonfly2_tpu.dfdaemon.DeleteTaskRequest\x1a\x1e.dragonfly2_tpu.dfdaemon.Emptyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dfdaemon_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=57
  _EMPTY._serialized_end=64
  _DOWNLOADREQUEST._serialized_start=67
  _DOWNLOADREQUEST._serialized_end=275
  _DOWNLOADRESULT._serialized_start=278
  _DOWNLOADRESULT._serialized_end=408
  _PIECETASKREQUEST._serialized_start=410
  _PIECETASKREQUEST._serialized_end=521
  _PIECEPACKET._serialized_start=524
  _PIECEPACKET._serialized_end=726
  _STATTASKREQUEST._serialized_start=728
  _STATTASKREQUEST._serialized_end=828
  _IMPORTTASKREQUEST._serialized_start=830
  _IMPORTTASKREQUEST._serialized_end=926
  _EXPORTTASKREQUEST._serialized_start=928
  _EXPORTTASKREQUEST._serialized_end=1046
  _DELETETASKREQUEST._serialized_start=1048
  _DELETETASKREQUEST._serialized_end=1130
  _DFDAEMON._serialized_start=1133
  _DFDAEMON._serialized_end=1797
# @@protoc_insertion_point(module_scope)
