"""Test suite (a package, so that ``tests.util`` resolves to this directory
ahead of any installed module of the same name)."""
