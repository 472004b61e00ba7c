"""The native host runtime: ``native`` (vertex welding, the OBJ writer and
reader in C++, built with g++ at first use)."""
