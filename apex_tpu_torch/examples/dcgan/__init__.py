"""The DCGAN example under mixed precision (:mod:`.main_amp`)."""
