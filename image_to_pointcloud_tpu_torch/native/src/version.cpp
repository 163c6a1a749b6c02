// Source-hash stamp for staleness detection (native/__init__.py).
//
// The build embeds a SHA-256 over every .cpp/.h in this directory via
// -DIPC_SOURCE_HASH="..."; the Python loader recomputes the hash over
// the checked-out sources and refuses to serve a library whose stamp
// does not match (a committed binary can otherwise silently shadow
// edited sources after a fresh clone, where uniform mtimes defeat any
// mtime-based check).
extern "C" const char* ipc_source_hash() {
#ifdef IPC_SOURCE_HASH
  return IPC_SOURCE_HASH;
#else
  return "";
#endif
}
