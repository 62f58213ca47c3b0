"""FAST/ORB front end and descriptor matching."""
