"""The v7.57 analytics pipeline of the port."""
